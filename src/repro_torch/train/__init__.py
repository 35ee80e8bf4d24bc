"""Step functions over the port's model (``steps``)."""
