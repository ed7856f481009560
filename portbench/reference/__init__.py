"""Plain float64 references, one module per configuration; they import nothing of the port."""
