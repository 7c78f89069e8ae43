"""Launchers of the model zoo: ``serve`` (batched prefill + greedy decode)."""
