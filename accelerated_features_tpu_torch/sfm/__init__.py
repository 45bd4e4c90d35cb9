"""SfM layer of the port. So far: the SO(3)/SE(3) utilities (`lie`)."""
