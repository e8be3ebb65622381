"""Part of the port's benchmark."""
