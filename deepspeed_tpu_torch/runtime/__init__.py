"""Training runtime of the port: config, engine, LR schedules and
``initialize``."""
