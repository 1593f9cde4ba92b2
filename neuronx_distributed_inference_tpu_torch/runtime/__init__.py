"""Runtime of the port: the sub-model runner and the application."""
