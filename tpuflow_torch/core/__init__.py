"""Physics of the port: the Gilbert choke-flow baseline."""
