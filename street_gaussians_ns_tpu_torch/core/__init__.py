"""Core math: quaternions, spherical harmonics, cameras, EWA projection."""
