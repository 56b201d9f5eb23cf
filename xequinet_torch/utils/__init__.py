"""Host utilities of the port: config schema, logging, units."""
