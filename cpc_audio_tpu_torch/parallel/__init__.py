"""Train and validation steps of the port (one device)."""
