"""tpu_air_torch.parallel — training steps across devices (one card so far)."""
