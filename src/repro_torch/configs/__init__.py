"""Published model configurations (structure only, no weights)."""
