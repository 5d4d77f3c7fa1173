"""Host-side batching: line records, batchers, prefetch, fg masks."""
