"""Analysis of human studies of generated lines."""
