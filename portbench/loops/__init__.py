"""One module per kind of loop, named by a traffic mix's ``loop``."""
