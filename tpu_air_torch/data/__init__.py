"""tpu_air_torch.data — the data layer of the port (its preprocessors so
far; datasets and ``map_batches`` over the runtime come with the
``BatchPredictor`` slice)."""
