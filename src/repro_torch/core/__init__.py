"""BTARD protocol core of the port (see the package docstring)."""
