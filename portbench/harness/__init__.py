"""The benchmark harness: the command, the drivers, the yardstick."""
