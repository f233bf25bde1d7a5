"""The plain float64 reference that decides ``correct``; it imports
nothing of the solver under test."""
