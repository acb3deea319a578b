"""The port's observability: so far only the Hysteresis gate the engine's
preemption policy reads (``control.py``)."""
