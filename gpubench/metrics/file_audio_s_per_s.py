"""Audio seconds of the transcriptions returned in the window over its seconds."""


def read(r):
    if "file_audio_s" not in r.samples:
        return None
    return r.samples["file_audio_s"] / r.window_s
