"""Serving tier of the port: for now, the plan fingerprint the stage cache
keys by (``plancache``)."""
