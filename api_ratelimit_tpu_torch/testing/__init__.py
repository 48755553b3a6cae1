"""Test helpers of the port (numpy-only copies of the reference's)."""
