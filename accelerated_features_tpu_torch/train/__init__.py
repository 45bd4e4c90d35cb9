"""Training-side data generation of the port; so far the numpy scene
renderer of the SLAM benchmark (`render`)."""
