"""Clients, one per kind of traffic a mix file names (``"client"``):
each sets up the system under test for a cell and loads it
(``Cell``)."""
