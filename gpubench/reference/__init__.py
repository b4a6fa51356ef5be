"""The plain reference that decides ``correct``: numpy, torch and the standard library only."""
