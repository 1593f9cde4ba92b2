"""Model building blocks of the port (functional, on tensors)."""
