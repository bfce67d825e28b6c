"""Plain references, written from the problem's definition; they import nothing of
the program."""
