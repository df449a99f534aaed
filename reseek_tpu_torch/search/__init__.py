"""Search drivers and the device engine of the port."""
