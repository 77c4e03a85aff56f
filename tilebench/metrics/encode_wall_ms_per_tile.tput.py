"""Program span "Compose and encode wall (batch share)" (the render thread's wall time from a sub-batch's first encode task to its last result, split over the sub-batch's tiles) summed over the window, per tile served; nothing where the program has no such span."""

ENCODE_WALL = "Compose and encode wall (batch share)"


def read(w):
    if not w.tiles_done or ENCODE_WALL not in w.spans:
        return None
    return 1e3 * w.spans[ENCODE_WALL] / w.tiles_done
