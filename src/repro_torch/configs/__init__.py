"""Model configurations of the port (own copies of the reference's)."""
