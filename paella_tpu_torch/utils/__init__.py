"""Host-side helpers: metric logging, step timing, eval image grids and profiling."""
