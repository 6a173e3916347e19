"""Traffic generators and mixes."""
