"""Importer CLI: `python -m osm_renderer_tpu_torch.cli.importer_main INPUT OUTPUT`.

Writes OUTPUT.tmp first and renames atomically; best-effort cleanup on
failure (reference: `bin/importer.rs`).
"""

import os
import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("Usage: importer INPUT OUTPUT", file=sys.stderr)
        return 1
    input_path, output_path = argv
    tmp_output = os.path.splitext(output_path)[0] + ".tmp"

    from osm_renderer_tpu_torch.geodata.importer import import_osm

    print(f"Importing OSM data from {input_path}")
    try:
        import_osm(input_path, tmp_output)
        os.replace(tmp_output, output_path)
    except Exception as err:
        try:
            os.remove(tmp_output)
        except OSError:
            pass
        print(err, file=sys.stderr)
        return 1
    print(f"Successfully imported OSM data to {output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
