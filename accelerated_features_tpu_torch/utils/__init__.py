"""Utilities of the port; so far image reading without cv2 (`imageio`)."""
