"""ETA serving: batcher, fast lane, WSGI app and entry point."""
