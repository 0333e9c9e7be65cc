"""Host-side data packing."""
