"""Host utilities (config parsing, logging)."""
