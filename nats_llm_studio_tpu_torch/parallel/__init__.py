"""Device-memory accounting (``memory.py``); the port serves on one card."""
