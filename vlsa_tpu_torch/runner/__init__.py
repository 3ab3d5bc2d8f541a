"""The serving engine and its command line."""
