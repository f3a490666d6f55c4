"""Shared configuration (re-exported from the reference), tensor types
and geometry."""
