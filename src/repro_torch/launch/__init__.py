"""Entry points of the port: LM serving (prefill and decode)."""
