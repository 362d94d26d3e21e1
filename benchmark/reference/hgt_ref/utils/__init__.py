"""Command-line parsing and checkpoint path resolution."""
