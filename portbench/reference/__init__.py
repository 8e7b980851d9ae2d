"""The plain reference that decides ``correct``: plain torch and numpy,
independent of the program under test (it imports nothing of it)."""
