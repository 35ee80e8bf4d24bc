"""Entry points of the port (``serve``: the elastic-KV serving driver)."""
