"""The model stack, ported for the dense and MoE families: architecture
configs (``config``), layers with the chunked flash attention
(``layers``), the MoE FFN (``moe``), the model's forward, loss, prefill
and paged decode (``model``) and the carry-over of reference parameters
and training state (``convert``)."""
