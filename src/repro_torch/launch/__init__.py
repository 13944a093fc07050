"""Launch tooling of the port: the data-axis mesh (``mesh``), the
device data plane's validated record (``db_plane``), the real-model serve
driver (``serve``), the training driver (``train``) and the roofline
bookkeeping (``roofline``)."""
