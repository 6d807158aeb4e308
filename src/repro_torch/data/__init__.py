"""Data substrate: synthetic KITS19-like cases and minimal NIfTI IO (numpy)."""
