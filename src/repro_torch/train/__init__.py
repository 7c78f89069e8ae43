"""Serving steps of the model zoo (``serve_step``); training comes later
(ROADMAP 1.9)."""
