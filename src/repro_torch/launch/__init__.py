"""Launch tooling of the port: the data-axis mesh (``mesh``), the
device data plane's validated record (``db_plane``) and the real-model
serve driver (``serve``)."""
