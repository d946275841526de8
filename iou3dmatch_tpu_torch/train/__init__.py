"""Weight import and the eval forward."""
