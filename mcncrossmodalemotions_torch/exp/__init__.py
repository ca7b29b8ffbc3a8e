"""exp subpackage: experiment entry points."""
