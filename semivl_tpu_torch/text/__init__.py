"""Text-embedding assets."""
