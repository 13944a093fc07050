"""Launch tooling of the port: the data-axis mesh and the production
mesh's descriptor (``mesh``), the device data plane's validated record
(``db_plane``), the real-model serve driver (``serve``), the training
driver (``train``), the sharding rules (``sharding``), the op counter and
the reference's HLO analyzer (``hlo_analysis``), the multi-pod dry run
(``dryrun``), the roofline bookkeeping (``roofline``) and the closed-loop
concurrent workload of the paper's §6.3 (``workload``)."""
