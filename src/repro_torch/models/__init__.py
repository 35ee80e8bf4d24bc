"""The model stack's decode path, ported: architecture configs
(``config``), layers, the dense decoder with its paged KV cache
(``model``) and the carry-over of reference parameters (``convert``)."""
