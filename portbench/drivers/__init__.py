"""Window drivers, one module per entry point a mix drives."""
