"""Runtime checks of the port (counterpart of the reference's ``analysis/``:
the retrace guard only)."""
