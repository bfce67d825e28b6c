"""The code that calls the program under test, one module a kind of call."""
