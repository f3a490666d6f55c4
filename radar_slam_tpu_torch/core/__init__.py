"""Configuration (the port's own copy), tensor types and geometry."""
