"""The plain reference that decides `correct`: plain torch and numpy,
float32 with TF32 off, importing nothing of the program."""
