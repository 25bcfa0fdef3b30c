"""Step-function builders (serving so far; training waits for its slice)."""
