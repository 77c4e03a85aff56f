class MapcssError(Exception):
    """Lexer/parser error with source position info.

    Mirrors `src/mapcss/mod.rs` in the reference: errors carry the
    (line, character) position and, for parse errors, the file name.
    """

    def __init__(self, message: str, line: int, character: int, file_name: str = ""):
        self.message = message
        self.line = line
        self.character = character
        self.file_name = file_name
        where = f"line {line}, col {character}"
        if file_name:
            super().__init__(f"parse error: {message} ({file_name} at {where})")
        else:
            super().__init__(f"lexer error: {message} (at {where})")
