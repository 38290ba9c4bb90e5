"""Host-side utilities of the PyTorch port: metrics sink, preemption guard, tracing."""
