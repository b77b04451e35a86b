"""Caption cleaning, the port's own copy of micro_diffusion_tpu/datasets/captions.py
(``basic_clean`` :24, ``clean_caption`` :30, ``CaptionProcessor`` :91): the DeepFloyd-IF
style sanitizer (reference captions.py:9-143) applied to cc12m's web-crawled alt-text
captions before the precompute (the only dataset the reference cleans, SURVEY.md
#2.3). Scrubs URLs, @-handles, HTML, CJK, file names, serial-number-like tokens, stray
quotes/dashes, and collapses whitespace; the full clean is applied twice like the
reference. The regular expressions are the JAX package's, character for character.

Deviation (the JAX package's too): the reference uses ftfy.fix_text for mojibake
repair; ftfy is not a dependency, so unicode NFC normalization + html unescape stand in
for it (the other regex passes are equivalent).
"""

import html
import re
import unicodedata
import urllib.parse as ul

BAD_PUNCT_REGEX = re.compile(
    r"[" + "#®•©™&@·º½¾¿¡§~" + r"\)" + r"\(" + r"\]" + r"\[" + r"\}" + r"\{" + r"\|"
    + "\\\\" + r"\/" + r"\*" + r"]{1,}"
)


def basic_clean(text: str) -> str:
    text = unicodedata.normalize("NFC", str(text))
    text = html.unescape(html.unescape(text))
    return text.strip()


def clean_caption(caption: str) -> str:
    caption = str(caption)
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    caption = re.sub("<person>", "person", caption)
    # urls
    caption = re.sub(
        r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",  # noqa
        "", caption)
    caption = re.sub(
        r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",  # noqa
        "", caption)
    # html tags
    caption = re.sub(r"<[^>]*>", "", caption)
    # @handles
    caption = re.sub(r"@[\w\d]+\b", "", caption)
    # CJK and other scripts
    for rng in (
        r"[\u31c0-\u31ef]+", r"[\u31f0-\u31ff]+", r"[\u3200-\u32ff]+",
        r"[\u3300-\u33ff]+", r"[\u3400-\u4dbf]+", r"[\u4dc0-\u4dff]+",
        r"[\u4e00-\u9fff]+",
    ):
        caption = re.sub(rng, "", caption)
    caption = re.sub(
        r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A\u2E3B"
        r"\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+",
        "-", caption)
    # quotes / dots
    caption = re.sub(r"[`´«»“”¨]", '"', caption)
    caption = re.sub(r"[‘’]", "'", caption)
    caption = re.sub(r"&quot;?", "", caption)
    caption = re.sub(r"&amp", "", caption)
    caption = re.sub(r"\d:\d\d\s+$", "", caption)
    caption = re.sub(r"\\n", " ", caption)
    # ip addresses and dates
    caption = re.sub(r"\d+\.\d+\.\d+\.\d+", " ", caption)
    caption = re.sub(r"\d+\.\d+\.\d+", " ", caption)
    # file names
    caption = re.sub(
        r"\b[a-zA-Z]{1,3}\d{3,15}\b", "", caption)  # j123 style ids
    caption = re.sub(r"\b\d+[a-zA-Z]+\d+\b", "", caption)
    caption = re.sub(r"(worldwide\s+)?(free\s+)?shipping", "", caption)
    caption = re.sub(r"(free\s)?download(\sfree)?", "", caption)
    caption = re.sub(r"\bclick\b\s(?:for|on)\s\w+", "", caption)
    caption = re.sub(
        r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?", "", caption)
    caption = re.sub(r"\bpage\s+\d+\b", "", caption)
    caption = re.sub(r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", r" ", caption)
    caption = re.sub(r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", "", caption)
    caption = re.sub(r"\b\s+\:\s+", r": ", caption)
    caption = re.sub(r"(\D[,\./])\b", r"\1 ", caption)
    caption = re.sub(r"\s+", " ", caption)
    caption.strip()  # a no-op (the result is dropped), kept as the JAX package has it
    caption = basic_clean(caption)
    caption = BAD_PUNCT_REGEX.sub(r" ", caption)
    caption = re.sub(r"\s+\.\s+", r" ", caption)
    caption = re.sub(r"(?:\-|\_)", " ", caption)
    caption = re.sub(r"\s+", " ", caption)
    return caption.strip()


class CaptionProcessor:
    """Apply the full clean twice (reference captions.py applies it twice)."""

    def __call__(self, caption: str) -> str:
        return clean_caption(clean_caption(caption))
