"""Traffic drivers, one file a kind, loaded by the name a cell gives (`harness.driver_module`)."""
