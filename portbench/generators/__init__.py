"""Matrix generators, one module per ``generator`` name of a configuration."""
