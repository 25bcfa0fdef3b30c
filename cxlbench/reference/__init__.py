"""Plain references the benchmark holds the program to; they import nothing of it."""
