"""Host-side video decode, image and record writers, needle diagrams."""
