"""Fleet resilience: step monitoring and preemption."""
