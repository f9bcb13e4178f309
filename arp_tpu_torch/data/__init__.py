"""Data assets of the port."""
