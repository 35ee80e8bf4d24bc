"""The synthetic data pipeline of the port (``pipeline``)."""
