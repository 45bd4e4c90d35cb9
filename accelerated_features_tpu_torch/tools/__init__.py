"""Developer tools of the port; nothing here is imported by the library."""
