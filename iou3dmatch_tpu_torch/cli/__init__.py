"""Driver plumbing of the port."""
