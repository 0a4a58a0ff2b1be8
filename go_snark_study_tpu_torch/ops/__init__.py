"""Device compute of the port."""
