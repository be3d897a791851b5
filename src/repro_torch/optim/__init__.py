"""Server-side optimizers."""
