"""Per-model glue between a configuration, the port's entry points and the reference."""
