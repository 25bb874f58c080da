"""tpu_air_torch.parallel — training steps across devices: the one-card LM
step and data parallelism over worker processes."""
