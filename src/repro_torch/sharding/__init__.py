"""How the port lays its flat server state over a mesh of ranks
(``rules``)."""
