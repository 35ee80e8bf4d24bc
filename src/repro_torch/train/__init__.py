"""Step functions over the port's model (``steps``): training, prefill
and serving."""
