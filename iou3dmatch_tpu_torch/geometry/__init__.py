"""Box geometry and NMS for the eval path."""
