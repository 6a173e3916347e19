"""FedNano core of the port: NanoEdge and NanoAdapters."""
