"""Port subpackage; see the package docstring."""
