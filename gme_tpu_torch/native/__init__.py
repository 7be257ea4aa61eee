"""The native host runtime (y4m decode, PNG writers), bound with ctypes."""
