"""Host-side prediction parsing."""
