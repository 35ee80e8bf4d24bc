"""Entry points of the port (``serve``: the elastic-KV serving driver;
``train``: the training driver)."""
