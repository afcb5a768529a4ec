"""The benchmark's own code: what later changes to the program cannot move."""
