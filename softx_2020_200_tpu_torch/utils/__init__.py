"""Host-side utilities: VTU/PVD writers, text tables."""
