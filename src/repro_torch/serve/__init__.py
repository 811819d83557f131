"""Serving: the multi-tenant streaming reservoir engine (reservoir.py, with
scheduler.py and state_store.py) — client streams slot-batched onto the
ensemble axis E."""
