"""Eval step of the port (the train step is not ported yet)."""
