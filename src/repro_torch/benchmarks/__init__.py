"""Benchmarks of the port (``python -m repro_torch.benchmarks.<name>``),
one module per figure or table of the paper, as ``benchmarks/``:

  run           -- the harness: every module below, ``name,value,derived``
                   rows and a JSON artifact (``--device``, ``--smoke``)
  fault_latency -- passive fault latency (Fig 14f / 15d), the scalar
                   reference path, batched-vs-scalar swap throughput, the
                   extent-size sweep, the slot allocator
  overhead      -- decode step with and without a live manager, and the
                   translated guest read (Fig 11 / 12)
  metadata      -- mpool use over a fill / reclaim / release cycle (Fig 13a)
  overcommit    -- elasticity, overselling gain, benefit against
                   metadata (Fig 13b)
  lru_accuracy  -- cold-set precision and recall of the LRU (Fig 15b)
  backend_ratio -- zero / compressed mix and compression ratio (Fig 15c)
  code_size     -- lines of code by module (Table 2)
  fleet         -- the fleet control plane: the paper trace, the chaos
                   trace and the captured serving workloads, each
                   replayed twice
  workload      -- the paper's page mix, and the ``Geometry`` a module
                   runs at on the card
"""
