"""Plain NumPy references that decide ``correct``.  They import nothing of
the program and take none of its derived data."""
