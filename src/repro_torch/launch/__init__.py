"""Launch tooling of the port: the data-axis mesh (``mesh``) and the
device data plane's validated record (``db_plane``)."""
