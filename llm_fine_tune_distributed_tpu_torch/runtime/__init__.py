"""Process-level runtime helpers of the port: the step watchdog."""
