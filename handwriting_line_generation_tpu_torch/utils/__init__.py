"""Host-side helpers: error rates and the training log."""
