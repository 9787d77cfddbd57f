"""Published pretrained-embedding catalogs
(reference: python/mxnet/contrib/text/_constants.py).

The SHA-1 values are the published checksums of the hosted GloVe /
fastText artifacts — factual catalog data the verification path needs.
The fastText wiki.* catalog lists ~300 languages upstream; this build
carries the headline entries in the same ``{file: sha1}`` format (extend
by adding entries, the loaders are format-agnostic).
"""

UNKNOWN_IDX = 0

# archives (what gets downloaded) -> sha1
GLOVE_ARCHIVE_SHA1 = {
    "glove.42B.300d.zip": "f8e722b39578f776927465b71b231bae2ae8776a",
    "glove.6B.zip": "b64e54f1877d2f735bdd000c1d7d771e25c7dfdc",
    "glove.840B.300d.zip": "8084fbacc2dee3b1fd1ca4cc534cbfff3519ed0d",
    "glove.twitter.27B.zip": "dce69c404025a8312c323197347695e81fd529fc",
}

# extracted text files (what gets loaded) -> sha1
GLOVE_FILE_SHA1 = {
    "glove.42B.300d.txt": "876767977d6bd4d947c0f84d44510677bc94612a",
    "glove.6B.50d.txt": "21bf566a9d27f84d253e0cd4d4be9dcc07976a6d",
    "glove.6B.100d.txt": "16b1dbfaf35476790bd9df40c83e2dfbd05312f1",
    "glove.6B.200d.txt": "17d0355ddaa253e298ede39877d1be70f99d9148",
    "glove.6B.300d.txt": "646443dd885090927f8215ecf7a677e9f703858d",
    "glove.840B.300d.txt": "294b9f37fa64cce31f9ebb409c266fc379527708",
    "glove.twitter.27B.25d.txt":
        "767d80889d8c8a22ae7cd25e09d0650a6ff0a502",
    "glove.twitter.27B.50d.txt":
        "9585f4be97e286339bf0112d0d3aa7c15a3e864d",
    "glove.twitter.27B.100d.txt":
        "1bbeab8323c72332bd46ada0fc3c99f2faaa8ca8",
    "glove.twitter.27B.200d.txt":
        "7921c77a53aa5977b1d9ce3a7c4430cbd9d1207a",
}

FAST_TEXT_FILE_SHA1 = {
    "crawl-300d-2M.vec": "9b556504d099a6c01f3dd76b88775d02cb2f1946",
    "wiki.en.vec": "c1e418f144ceb332b4328d27addf508731fa87df",
    "wiki.simple.vec": "55267c50fbdf4e4ae0fbbda5c73830a379d68795",
}

FAST_TEXT_ARCHIVE_SHA1 = {
    "crawl-300d-2M.zip": "bb40313d15837ceecc1e879bc954e9be04b17c3c",
    "wiki.en.zip": "7f83d578a31a8168423c77ea25ad381494a5e920",
    "wiki.simple.zip": "367737535e39defb0e713a7ff2374cb932c5a9bc",
}
