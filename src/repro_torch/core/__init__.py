"""IGPM core: dynamic graph, RWR, queries, G-Ray bank matcher, PEM."""
