"""The plain reference the port's outputs are held against (plain.py)."""
