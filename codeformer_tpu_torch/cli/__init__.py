"""Command-line interfaces."""
